"""layer_fwd_ms: milliseconds of the PDE layer's forward call (the model's
`layer(coeffs, rhs, iv, steps)`: fill, hierarchy or factor, forward solve),
a mean over the traced run's window steps.  Span `layer`, synchronized at
both ends."""


def read(obs):
    t = obs.spans.get("layer")
    return 1e3 * sum(t) / len(t) if t else None
