"""enqueue_ms.sar (ms): the host's time to enqueue one block's calls into
the port (``core/fft.py``, ``kernels/ops.py``), on the host clock with no
synchronise; the mean over the blocks outside the traced slice."""

from portbench.readers import mean_enqueue_ms as read  # noqa: F401
