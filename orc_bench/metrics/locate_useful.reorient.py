"""locate_useful.reorient: the DP cells the window's INFIX scans needed
(each read's own length by the primers' lengths) over the cells the
program's locate launches covered (its ``locate.cells_launched``: reads
x padded length x primers x DP rows), in %: the share of the launched
DP that the reads needed."""
from orc_bench import peaks


def read(layer):
    cells = layer.get("program", {}).get("counters", {}).get(
        "locate.cells_launched")
    ops = layer.get("counts", {}).get("locate_ops")
    if not cells or not ops:
        return None
    return 100.0 * ops / peaks.OPS_PER_LOCATE_CELL / cells
