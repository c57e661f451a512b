"""Files written as PNG per second over the time of the window's
``develop_files`` calls (the call in progress at the window's end included),
host clock."""


def read(run):
    if not run.files or run.busy_window_s <= 0:
        return None
    return run.files / run.busy_window_s
