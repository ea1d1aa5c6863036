"""The 95th percentile, over every request due in the window, of its
return time less its due time; a failed request counts as infinite."""
import numpy as np


def read(record):
    if not record.get('latency_ms'):
        return None
    return float(np.percentile(record['latency_ms'], 95, method='higher'))
