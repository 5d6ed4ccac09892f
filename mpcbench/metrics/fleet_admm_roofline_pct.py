"""csrc/fleet_admm.cu's share of its roofline: the bound of
counts/fleet_admm.py over the kernel's mean device time per launch in the
traced sub-window."""


def read(rec):
    kt = rec["kernel_time"]("fleet_admm_kernel")
    if kt is None:
        return None
    b = rec["counts"]("fleet_admm").bound(rec["config"], rec["scenarios"],
                                          rec["candidates"], rec["peaks"])
    return 100.0 * b["seconds"] / kt[1]
