"""build_case_s: seconds build_case took (host clock); its share of
setup_s."""


def read(record):
    return record.get("build_case_s")
