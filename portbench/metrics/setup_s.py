"""setup_s: seconds from the run's start to the end of the warm-up cycle:
loading the deck, build_case, the solver (its kernels built or loaded) and
one run_cycle; the copy of the initial state that the comparison keeps is
left out."""


def read(record):
    return record.get("setup_s")
