"""Device operations (kernels, copies, fills) per closed-loop cycle in the
traced sub-window: the host launches that set the batch's pace."""


def read(rec):
    if not rec["ops"]:
        return None
    return len(rec["ops"]) / rec["traced_cycles"]
