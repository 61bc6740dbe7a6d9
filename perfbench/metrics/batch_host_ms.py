"""batch_host_ms: host milliseconds a step spends fetching its batch from
the port's PatchLoader (the NumPy patch stacking; the copy to the device
happens in the model's loss_fn, inside layer_fwd_ms's step), a mean over the
traced run's window steps.  Span `batch`, synchronized at both ends."""


def read(obs):
    t = obs.spans.get("batch")
    return 1e3 * sum(t) / len(t) if t else None
