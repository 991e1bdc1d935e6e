"""viterbi_useful.extract: the Viterbi cells the window's samples needed
(``viterbi_cells``, as ``viterbi_roofline.extract`` counts them) over the
cells the program's scans covered (its ``viterbi.cells_launched``:
sequences x padded length x nodes, a launch), in %: the share of the
launched work that the contigs needed."""


def read(layer):
    launched = layer.get("program", {}).get("counters", {}).get(
        "viterbi.cells_launched")
    cells = layer.get("counts", {}).get("viterbi_cells")
    if not launched or not cells:
        return None
    return 100.0 * cells / launched
