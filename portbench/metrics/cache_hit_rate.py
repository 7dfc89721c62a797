"""The program's cache hit share in the traced steps, in percent: each
step's hits that the ``pinned_hot`` fetch reports over the worker's valid
frontier ids (the bottom level's sources), the workers' mean as the
driver's ``cache_hit_rate`` metric gives it, averaged over the steps.
Nothing to read where the mix has no cache."""
NAME = "cache_hit_rate"
UNIT = "%"
LAYER = "feature fetch"
SOURCE = "program_counter"
RUN = "traced"
MOVES = "train_seeds_per_device_s"


def read(run):
    if run.trace is None or not run.mix["cache_capacity"]:
        return None
    shares = run.trace["hit_share"]
    return 100.0 * sum(shares) / len(shares)
