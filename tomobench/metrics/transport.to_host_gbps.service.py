"""transport.to_host_gbps.service: the same rate over a service cell's
sweeps (each variant's volume read off the card)."""
from tomobench.copies import TO_HOST, gbps


def read(rec):
    return gbps(rec, TO_HOST)
