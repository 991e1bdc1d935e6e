"""viterbi_roofline.extract: the least time of the Viterbi work that the
window's samples needed (``orc_bench/peaks_fp32.py``: each contig's own
length by the scanned profiles' nodes, over both strands, the forward
and the reversed scan and both genes, 15 float32 operations a cell at
3.35e13/s; counted into ``viterbi_cells`` by the stage module) over the
device time of the Viterbi kernels (``viterbi_kernel`` and
``viterbi_warp_kernel`` in the trace), in %."""
from orc_bench import peaks_fp32


def read(layer):
    dev = sum(s for n, s in layer.get("trace", {}).get("kernel_s", {}).items()
              if n.startswith(("viterbi_kernel", "viterbi_warp_kernel")))
    cells = layer.get("counts", {}).get("viterbi_cells")
    if dev <= 0 or not cells:
        return None
    return 100.0 * peaks_fp32.viterbi_least_seconds(cells) / dev
