"""csrc/ew_chain.cu's share of its roofline: the bound of counts/ew_chain.py
over the kernel's mean device time per launch in the traced sub-window."""


def read(rec):
    kt = rec["kernel_time"]("ew_chain_kernel")
    if kt is None:
        return None
    b = rec["counts"]("ew_chain").bound(rec["config"], rec["scenarios"],
                                        rec["candidates"], rec["peaks"])
    return 100.0 * b["seconds"] / kt[1]
