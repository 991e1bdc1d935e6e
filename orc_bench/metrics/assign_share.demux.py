"""assign_share.demux: the share of the window spent inside
``FusedDemux.assign`` calls (host clock around each; each call ends in
its fetches), in %. The rest is the stream's record handling and gz
writing."""


def read(layer):
    s = layer.get("spans", {}).get("assign")
    return None if s is None else 100.0 * s / layer["window_s"]
