"""device.idle_share: the share of the traced call in which no device
operation ran (1 - the union of their intervals over the call), in
percent."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or tr["window_s"] <= 0 or tr["device_ops"] == 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
