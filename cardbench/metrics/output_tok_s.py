"""output_tok_s: output tokens of every request of the window over the
whole window (first due time to last completion, on the wall-paced
timeline)."""


def read(run):
    tokens = sum(len(c.tokens) for c in run.completions.values())
    return tokens / run.window_s if run.window_s > 0 else None
