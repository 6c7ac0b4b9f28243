"""Metric readers: one module per metric named in BENCHMARK.json, each
with `read(ctx) -> float | None`.  A reader that finds nothing to read
returns None, and the run leaves the metric out of its line.

ctx (built by `benchmark.run`):
  samples_per_image  pixel samples of one image (width x height x spp)
  setup_s            process start to the window's start
  compile_s          the port's host-side scene compile in set-up
  window_s           the window's wall time (whole images)
  images             per window image: seconds, rays, steps (the
                     driver's stats), batches (batch driver only)
  peak_bytes         torch.cuda.max_memory_allocated over the window
  trace              the traced section (devtrace.run_traced) with its
                     images' stats under "images"; None untraced
"""
