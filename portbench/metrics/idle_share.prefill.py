"""idle_share.prefill (%): the share of the traced slice in which no
operation ran on the device (waiting for arrivals included)."""

from portbench.readers import idle_share as read  # noqa: F401
