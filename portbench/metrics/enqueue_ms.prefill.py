"""enqueue_ms.prefill (ms): the host time from the start of a request's
prefill to the return of ``Engine.prefill`` (``serving/engine.py``,
``models/model.py``), before its token is read back; the mean over the
requests outside the traced slice."""

from portbench.readers import mean_enqueue_ms as read  # noqa: F401
