"""The loop's wait for batches in training: the Trainer's ``data_time``
summed over the untraced sub-window's steps, as a share of that
sub-window's time (the loader layer: ``data/loader.py``, ``data/mapper.py``,
``data/record_dataset.py``)."""


def read(ctx):
    if ctx.get("kind") != "train" or not ctx["untraced_s"]:
        return None
    return 100.0 * ctx["data_time_s"] / ctx["untraced_s"]
