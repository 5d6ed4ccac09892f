"""Share of the traced sub-window in which no device operation ran."""


def read(rec):
    if not rec["ops"] or rec["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["window_s"])
