"""Peak device memory allocated during the window
(``torch.cuda.max_memory_allocated`` after ``reset_peak_memory_stats`` at
its start), in GiB."""

UNIT, BETTER, LAYER, MOVES, SOURCE = "GiB", "lower", "device memory", "train_tokens_per_s", "program_counter"


def read(ctx):
    peak = ctx.records.get("window_peak_bytes")
    if ctx.mode != "train" or not peak:
        return None
    return peak / 2**30
