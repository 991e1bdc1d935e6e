"""enumerate_share.reorient: the share of the window that stage 01 spent
on fused-read rescue, the program's ``reorient.enumerate`` (masked
re-scans) and ``reorient.schedule`` (interval scheduling) spans, host
clock, in %."""


def read(layer):
    sp = layer.get("program", {}).get("spans", {})
    if "reorient.enumerate" not in sp:
        return None
    t = sp["reorient.enumerate"]["total_s"] + sp.get(
        "reorient.schedule", {}).get("total_s", 0.0)
    return 100.0 * t / layer["window_s"]
