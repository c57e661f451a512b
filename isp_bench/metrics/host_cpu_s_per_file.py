"""Host CPU seconds (user + system, every thread of the process, by
``resource.getrusage``) in the window per file written."""


def read(run):
    if not run.files:
        return None
    return run.cpu_s / run.files
