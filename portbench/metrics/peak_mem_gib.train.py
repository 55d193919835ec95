"""The process's peak of allocated device memory over set-up and the
window (`torch.cuda.max_memory_allocated`), in GiB: what bounds the batch a
card holds."""


def read(w):
    return None if w.peak_bytes is None else w.peak_bytes / 2**30
