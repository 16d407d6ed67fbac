"""One driver per traffic mix ``kind``: ``drivers/<kind>.py`` defines
``DRIVER``, a :class:`tomobench.harness.Driver`."""
