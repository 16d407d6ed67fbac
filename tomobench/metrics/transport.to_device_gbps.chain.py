"""transport.to_device_gbps.chain: the bytes of the
``transport.to_device`` spans (each raw band handed from host memory
to the card) over their summed walls, GB/s."""
from tomobench.copies import TO_DEVICE, gbps


def read(rec):
    return gbps(rec, TO_DEVICE)
