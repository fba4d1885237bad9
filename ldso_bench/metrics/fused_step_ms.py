"""Host milliseconds a call of the per-frame program,
``frame_step.fused_step`` (pyramid, tracker, trace), over the window."""

SPANS = {"fused_step": ["ldso_tpu_torch.frame_step:fused_step"]}


def read(ctx):
    ms = ctx.spans.get("fused_step")
    return sum(ms) / len(ms) if ms else None
