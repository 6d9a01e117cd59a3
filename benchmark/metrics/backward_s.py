"""backward_s: the mean of the benchmark's spans around
``torch.autograd.grad`` (host clock, a synchronize before and after),
one a step, over the window's steps."""


def read(run):
    spans = run.ctx.spans.get("backward")
    return sum(spans) / len(spans) if spans else None
