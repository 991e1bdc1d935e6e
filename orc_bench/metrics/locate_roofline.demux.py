"""locate_roofline.demux: the least time of the locate work the window's
``assign`` calls needed (``orc_bench/peaks.py``) over the device time of
the locate kernels (``locate_kernel`` in the trace), in %."""
from orc_bench import peaks


def read(layer):
    dev = sum(s for n, s in layer.get("trace", {}).get("kernel_s", {}).items()
              if n.startswith("locate_kernel"))
    c = layer.get("counts", {})
    if dev <= 0 or not c.get("locate_ops"):
        return None
    return 100.0 * peaks.least_seconds(c["locate_ops"],
                                       c["locate_bytes"]) / dev
