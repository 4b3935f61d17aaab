"""idle_share.sar (%): the share of the traced slice in which no operation
ran on the device."""

from portbench.readers import idle_share as read  # noqa: F401
