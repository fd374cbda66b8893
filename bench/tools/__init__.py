"""Tools that measure what the benchmark's cells are set from (the
readings that set each correctness limit, the serving rate sweep); the
benchmark's own runs do not call them."""
