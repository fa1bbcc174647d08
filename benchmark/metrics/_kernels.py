"""Shared by the kernel roofline readers: the profiled call's device
seconds of the kernels whose names hold one of the given substrings."""


def device_s(rec, names):
    tr = rec.get("trace")
    if tr is None:
        return None
    s = sum(v for k, v in tr["kernel_s"].items()
            if any(n in k for n in names))
    return s if s > 0 else None


def roofline_pct(rec, least_key, names):
    least = rec["least_s"].get(least_key)
    spent = device_s(rec, names)
    if least is None or spent is None:
        return None
    return 100.0 * least / spent
