"""Host milliseconds a decoded job of the window spends outside the coded
step's call: the master loop (the straggler gate, the scheme's step and
collect, the decode weights), the job's batch and its coded view, the loss
read back.  From the harness's spans around each call of the step, each
ended by a synchronize."""


def read(ctx):
    w = ctx.window
    if not w["jobs"] or not w["step_s"]:
        return None
    return (w["wall_s"] - w["step_s"]) / w["jobs"] * 1e3
