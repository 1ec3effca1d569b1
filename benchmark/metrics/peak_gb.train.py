"""`torch.cuda.max_memory_allocated` over the window, in GB (kind "train")."""


def read(r):
    if r.get("kind") != "train" or not r.get("window_peak_bytes"):
        return None
    return r["window_peak_bytes"] / 1e9
