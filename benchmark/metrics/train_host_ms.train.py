"""Mean host milliseconds from a train step's call to its return, without
a synchronise: what the host spends enqueuing a step (kind "train")."""


def read(r):
    d = r["spans"].get("train_step")
    if r.get("kind") != "train" or not d:
        return None
    return 1e3 * sum(d) / len(d)
