"""Host time of one ``enroll_shots`` call (it returns once the bank update
has landed), in ms: the sum over the window's enrollments outside the
profiler over their count."""


def read(ctx):
    walls = ctx.walls.get("enroll", [])
    if not walls:
        return None
    return 1e3 * sum(walls) / len(walls)
