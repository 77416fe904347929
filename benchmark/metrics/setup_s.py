"""setup_s (s): from the start of the harness's process to the window's
first step: imports, the CUDA context, the pipeline's build, the kernel's
load and the warm-up."""


def read(rec):
    return rec.get("setup_s")
