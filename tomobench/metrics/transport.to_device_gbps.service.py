"""transport.to_device_gbps.service: the same rate over a service
cell's sweeps (each variant's raw band handed to the card)."""
from tomobench.copies import TO_DEVICE, gbps


def read(rec):
    return gbps(rec, TO_DEVICE)
