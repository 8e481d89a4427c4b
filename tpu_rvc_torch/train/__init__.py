"""GAN training on one device: data preparation, the D-then-G step, the
loop with checkpoints and the small-model export."""
