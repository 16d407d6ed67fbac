"""slices_per_s: reconstructed slices of the requests completed inside
the window (every volume in host memory by its end) over the window.  A
closed loop's window ends at its last completion; an open loop's at its
close, so that a request still queued then completes nothing."""


def read(rec):
    span = rec.t1 - rec.t0
    done = [r for r in rec.done() if r.end <= rec.t1]
    if not done or span <= 0:
        return None
    return sum(r.slices for r in done) / span
