"""Plan search beyond Algorithm 1: the closed-loop autotuner
(:mod:`repro_torch.optim.autotune`), which measures every candidate plan
through the pipelined streamer on the card."""
