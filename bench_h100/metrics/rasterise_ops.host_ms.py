"""rasterise_ops.host_ms: host wall ms a step inside the benchmark's spans
around the entry-point call and loss.backward(), over every step of a
traced run's window: the port's dispatch, autograd and launch work on the
host, and every wait for the device inside those calls (at the blocks
packs' synchronising host-to-device copies), so a device-side gain moves
it too."""


def read(readings):
    if not readings.host_steps:
        return None
    seconds = readings.host_seconds
    total = seconds.get("rasterise", 0.0) + seconds.get("backward", 0.0)
    return 1e3 * total / readings.host_steps
