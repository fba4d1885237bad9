"""Host milliseconds a keyframe of the seeding and the tracker-ref rebuild:
``_dispatch_seed``, ``_seed_new_kf`` and ``_update_tracker_ref`` over the
window, over its keyframes."""

SPANS = {"seed_ref": ["ldso_tpu_torch.system:FullSystem._dispatch_seed",
                      "ldso_tpu_torch.system:FullSystem._seed_new_kf",
                      "ldso_tpu_torch.system:FullSystem._update_tracker_ref"]}


def read(ctx):
    ms = ctx.spans.get("seed_ref")
    return sum(ms) / ctx.keyframes if ms and ctx.keyframes else None
