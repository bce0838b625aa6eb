"""Share of the traced window in which nothing ran on the card, in the DKL
training window: the reading of `device.idle_share.train` on this cell's
records."""
from gpbench.harness import manifest


def read(rec):
    return manifest.load_reader("device.idle_share.train")(rec)
