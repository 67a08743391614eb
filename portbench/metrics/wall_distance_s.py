"""wall_distance_s: seconds of the set-up's nearest-wall search, the
program's ``case.wall_distance`` spans (inside ``build_case``); its share of
setup_s."""


def read(record):
    recs = record.get("spans")
    if not recs:
        return None
    got = [r for r in recs if r["name"] == "case.wall_distance"]
    if not got:
        return None
    return sum((r["end_ns"] - r["start_ns"]) * 1e-9 for r in got)
