"""output_tokens_per_s: every output token produced inside the window (the
prefill's first token and each decoded one) over the window's seconds.
Host clock."""


def read(run):
    return run.window.tokens / run.window.seconds if run.window.seconds > 0 else None
