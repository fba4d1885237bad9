"""Share of BA's LM trials that were accepted over the window, in %:
100 * `ba.accepted` / `ba.trials` (counters in `ba.solve.run_ba`)."""

from ldso_bench.harness import program_spans


def read(ctx):
    c = program_spans.counts(ctx)
    if not c or not c.get("ba.trials"):
        return None
    return 100.0 * c.get("ba.accepted", 0) / c["ba.trials"]
