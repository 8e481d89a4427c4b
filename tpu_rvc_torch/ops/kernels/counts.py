"""Launch counters: one plain integer per kernel wrapper."""

launch_counts = {"banded_rel_attention": 0, "fused_stage": 0,
                 "fused_resblock": 0}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0
