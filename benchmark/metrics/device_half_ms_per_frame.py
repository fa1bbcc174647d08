"""Entry, device half: host milliseconds of the port's public device-half
call for one batch (it returns the decided grids on the host), a frame."""


def read(rec):
    s = rec["spans"].get("device_half_s")
    return None if s is None else s * 1e3 / rec["counters"]["frames"]
