"""``setup_s``: the seconds from the process's start to the window's start: imports, the
card's start, the kernels' libraries, the traffic, the program's set-up and its first
epochs."""


def read(run) -> float | None:
    return run.setup_s
