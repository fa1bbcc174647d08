"""Host half: host milliseconds of the native CABAC pack of one batch's
decided grids into container streams, a frame."""


def read(rec):
    s = rec["spans"].get("host_pack_s")
    return None if s is None else s * 1e3 / rec["counters"]["frames"]
