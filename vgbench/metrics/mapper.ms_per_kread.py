"""Host time in Mapper.map_reads, or begin_map + finish_map, on either
thread, ms per thousand reads."""


def read(record):
    s = record["layers"].get("mapper")
    return None if s is None or not record["reads"] else s * 1e6 / record["reads"]
