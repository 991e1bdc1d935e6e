"""myers_roofline.sort: the least time of the Myers work the window's
scorer calls needed (``orc_bench/peaks.py``) over the device time of the
Myers kernels (``myers_kernel``, ``myers_warp_kernel`` in the trace), in
%."""
from orc_bench import peaks


def read(layer):
    dev = sum(s for n, s in layer.get("trace", {}).get("kernel_s", {}).items()
              if n.startswith("myers_"))
    c = layer.get("counts", {})
    if dev <= 0 or not c.get("myers_ops"):
        return None
    return 100.0 * peaks.least_seconds(c["myers_ops"],
                                       c["myers_bytes"]) / dev
