"""Set-up: from the start of the process to the start of the window
(imports, the card, loading the release, the inputs, warm-up and, in a
fresh checkout, the kernel build). Host clock."""


def read(run):
    return run.setup_s
