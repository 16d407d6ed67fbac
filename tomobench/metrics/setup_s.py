"""setup_s: seconds from the process's start to the window's first
request (imports, CUDA contexts, the scans, the kernel library, the
warm-up requests)."""


def read(rec):
    return rec.setup_s
