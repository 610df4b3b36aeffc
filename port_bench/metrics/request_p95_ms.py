"""The 95th percentile, in ms, of a request's latency (predictions on
the host - its scheduled arrival) over the requests due before the
first traced span opened, by the host's clock."""

import numpy as np


def read(view):
    lat = view.info["record"].get("untraced_lat")
    if lat is None or len(lat) == 0:
        return None
    return float(np.percentile(lat, 95)) * 1e3
