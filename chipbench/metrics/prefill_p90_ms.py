"""The 90th percentile of the latency of the window's requests (host
clock, ms).  Every request of a step shares its step's wall, so this is
the 90th percentile of the steps' walls (inclusive quantiles)."""
import statistics


def read(run):
    if len(run.walls) < 2:
        return None
    return 1e3 * statistics.quantiles(run.walls, n=10,
                                      method="inclusive")[-1]
