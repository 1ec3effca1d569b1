"""Images done in the window over the window's length: served images
whose detections reached the host, or trained images with the last
step's device work included."""


def read(r):
    return r["images"] / r["window_s"]
