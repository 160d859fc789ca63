"""planner_ms_per_s: host milliseconds spent planning per second of the
window: the wall times of the telemetry recorder's ``engine.resolve`` spans
(each submit's plan resolution through the ``PlanCache``) and
``engine.replan_pass`` spans (a re-plan on drift) emitted in the traced
part of the window."""

SPANS = ("engine.resolve", "engine.replan_pass")


def read(ctx):
    walls = [e.wall_s for e in ctx.events
             if e.kind == "span" and e.name in SPANS and e.wall_s is not None]
    if not walls:
        return None
    return 1e3 * sum(walls) / ctx.window_s
