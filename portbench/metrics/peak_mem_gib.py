"""The card's peak of allocated memory over the window
(``torch.cuda.max_memory_allocated`` after a reset at its start), GiB."""


def read(rec):
    return rec['peak_bytes'] / 2 ** 30 if rec['peak_bytes'] else None
