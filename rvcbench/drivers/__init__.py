"""One driver a program entry point: `offline` (`VC.vc_single`), `serve`
(`SlotScheduler.tick`).  Each has a `Driver(cell, cfg, seed, device,
tmp)` with `setup()`, `window(seconds, tracer)`, `release()`,
`check(rec)` and `count(rec)`."""
