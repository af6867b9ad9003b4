"""Members a launch carried: the mean of the batcher's
``serve_batch_occupancy`` over the launches of the window."""

UNIT = "members"


def read(ctx):
    occ = ctx.get("occupancy")
    if ctx.get("kind") != "serve" or not occ:
        return None
    return sum(occ) / len(occ)
