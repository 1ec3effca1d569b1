"""Images trained in the window over the window's length, the last step's
device work included: img_per_s's reader."""

from benchmark.harness.common import reader

read = reader("img_per_s")
