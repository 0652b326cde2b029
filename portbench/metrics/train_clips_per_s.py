"""train_clips_per_s.*: the clips of every train step the window completed,
over the window's seconds (host clock, each step to its own sync)."""


def read(w):
    return w.clips / w.window_s
