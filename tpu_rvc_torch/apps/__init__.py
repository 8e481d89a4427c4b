"""Front ends of tpu_rvc_torch: `python -m tpu_rvc_torch.apps.<name>`."""
