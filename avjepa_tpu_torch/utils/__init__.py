"""Weight bridges, checkpoint reading, and ``env_flag`` (the port's copy of
``avjepa_tpu/utils/__init__.py``)."""

import os


def env_flag(name: str, default: bool = False) -> bool:
    """Tolerant boolean env parse: accepts 1/0, true/false, yes/no, on/off.

    Preemption supervisors set flags like ``AVJEPA_RESUME_PREEMPT=true``;
    crashing on a non-integer spelling at relaunch time would defeat the
    variable's purpose (resuming after SIGTERM), so unknown values fall back
    to ``default`` with no exception.
    """
    raw = os.environ.get(name)
    if raw is None:
        return default
    val = raw.strip().lower()
    if val in ("1", "true", "yes", "on", "y"):
        return True
    if val in ("0", "false", "no", "off", "n", ""):
        return False
    import logging

    logging.getLogger(__name__).warning(
        "%s=%r not understood; using %s", name, raw, default
    )
    return default
