"""Audio whose alignment completed in the window, over the window's
wall time (failed rows count as attempted, not completed)."""


def read(ctx):
    return ctx.record.audio_s / ctx.record.window_s
