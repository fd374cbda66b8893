"""The plain reference: the benchmark's inputs made from the seed, the
direct sum and the numbers that compare an answer with it. Plain numpy
and torch; imports nothing of the port."""
