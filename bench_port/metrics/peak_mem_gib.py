"""``torch.cuda.max_memory_allocated()`` from the weights in their served
form through the window, in GiB."""


def read(rec):
    return rec["peak_bytes"] / 2 ** 30
