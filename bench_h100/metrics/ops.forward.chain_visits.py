"""ops.forward.chain_visits: the most tile-block visits one thread block
of K1 (csrc/raster_sweep.cu) sweeps, over the traced steps' images.  The
port's forward.chain counter (in the dirt.forward.sweep span) gives each
step's longest block: a run's visits, or the piece a long run is cut
into.  K1's time follows its longest dependent chain, not its total
work.  Nothing where the port counts none."""

from bench_h100.harness.stages import traced_records

NAME = "forward.chain"


def read(readings):
    spans = traced_records(readings)
    if spans is None:
        return None
    chains = [r.counters[NAME] for r in spans if NAME in r.counters]
    if not chains:
        return None
    return float(max(chains))
