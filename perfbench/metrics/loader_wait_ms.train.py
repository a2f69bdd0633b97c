"""The step's wait for its batch: the mean of ``Trainer``'s ``data_time``
(the host's time in ``next`` on the loader, in the step's thread: the
workers' reads not yet done, the nvJPEG decode and the LSJ augment on the
card) over the window's steps."""

import statistics

LAYER = "loader (data/loader.py, data/dataset_mapper.py, data/image_io.py)"
UNIT = "ms"
MOVES = "train_img_per_s"


def read(run):
    waits = run.extra.get("data_time_ms")
    return statistics.mean(waits) if waits else None
