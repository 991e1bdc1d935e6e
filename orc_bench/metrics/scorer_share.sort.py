"""scorer_share.sort: the share of the window spent inside the public
calls into ``cluster/scoring.py::DeviceScorer`` (host clock around each;
each ends in a fetch), in %. The rest is the sorter's Python, the native
consensus and file I/O."""


def read(layer):
    s = layer.get("spans", {}).get("scorer")
    return None if s is None else 100.0 * s / layer["window_s"]
