"""Host seconds from the first ``add_frame`` to the frame that initializes
(the bootstrap, ``init2f.CoarseInitializer`` with K6), inside set-up."""


def read(ctx):
    return ctx.bootstrap_s
