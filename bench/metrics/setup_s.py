"""setup_s: seconds from process start to the window's opening (loading,
weights, the program's quantize-and-deploy, kernel builds, warm-up of the
cell's shapes, and the ramp to steady load)."""


def read(rec):
    return rec.setup_s
