"""bwd_ms: milliseconds of the step's `loss.backward()` (the IFT backward
solve and the networks' backward), a mean over the traced run's window
steps.  Span `backward`: from the loss's return to the optimizer's step,
synchronized at both ends."""


def read(obs):
    t = obs.spans.get("backward")
    return 1e3 * sum(t) / len(t) if t else None
