"""Host milliseconds a call of the windowed BA, ``ba.solve.run_ba``."""

SPANS = {"run_ba": ["ldso_tpu_torch.ba.solve:run_ba"]}


def read(ctx):
    ms = ctx.spans.get("run_ba")
    return sum(ms) / len(ms) if ms else None
