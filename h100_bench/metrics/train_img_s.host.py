"""Images of the training steps of the untraced sub-window over its time:
the rate at which the host's issue of each step lets the device work (the
end-to-end ``train_img_s``, read where the host's pace spreads too widely
between runs for an end-to-end bound)."""


def read(ctx):
    if ctx.get("kind") != "train" or not ctx["untraced_s"]:
        return None
    return ctx["untraced_n"] * ctx["batch"] / ctx["untraced_s"]
