"""Padded rows (%) of all rows the serving plane dispatched in the window.

Each wave's requests of one bucket go out in chunks of at most the
plane's ``max_batch``, in order; a chunk takes ``batch`` (the width its
reports name) rows of ``bucket`` particles, of which the requests' own
``n`` are real and the rest padding (tail particles and filler rows)."""


def read(run, scope):
    waves = run.readings.get("dispatched")
    if not waves:
        return None
    mb = run.params["max_batch"]
    rows = real = 0
    for wave in waves:
        by_bucket: dict = {}
        for bucket, batch, n in wave:
            by_bucket.setdefault(bucket, []).append((batch, n))
        for bucket, reqs in by_bucket.items():
            for s in range(0, len(reqs), mb):
                chunk = reqs[s:s + mb]
                rows += chunk[0][0] * bucket
                real += sum(n for _, n in chunk)
    return 100.0 * (rows - real) / rows if rows else None
