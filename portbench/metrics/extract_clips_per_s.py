"""extract_clips_per_s: the clips embedded and copied to the host in the
window, over the window's seconds (host clock)."""


def read(w):
    return w.clips / w.window_s
