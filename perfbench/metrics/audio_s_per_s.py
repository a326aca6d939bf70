"""Valid audio-seconds whose features were completed in the window, over
the window's seconds (the window ends at a synchronize)."""


def read(run):
    return run.window.audio_s / run.window.seconds
