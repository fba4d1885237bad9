"""Host milliseconds a keyframe of the keyframe path,
``FullSystem._make_keyframe`` (activation, BA, seeding and the tracker
ref, ``_finish_kf``'s marginalization), over the window."""

SPANS = {"kf_path": ["ldso_tpu_torch.system:FullSystem._make_keyframe"]}


def read(ctx):
    ms = ctx.spans.get("kf_path")
    return sum(ms) / len(ms) if ms else None
