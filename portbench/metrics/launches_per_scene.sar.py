"""launches_per_scene.sar (launches): the port's kernel launches over the
window, by the kernel modules' ``COUNTS`` (the plain versions' counters
left out), divided by the scenes completed."""


def read(record):
    return sum(record.counters.values()) / len(record.requests)
