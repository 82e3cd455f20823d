# Trace-driven continuous-batching serving simulator with ALA-in-the-loop
# autoscaling, a copy of the reference package's serving/ over the port's
# ALA and OnlineALA.  Layers:
#   traces     — workload trace generators (arrival processes x shape
#                mixes; multi-tenant fleet traces with diurnal/flash
#                envelopes and per-tenant SLO tiers)
#   simulator  — discrete-event continuous-batching replica fleet
#   fleet      — time-bucketed vectorized engine for fleet-scale runs
#                (100k+ requests; simulate(..., engine="fleet")), its
#                decode trajectories in numpy or, traj_backend="torch",
#                on the GPU
#   autoscaler — control policies (static baseline, ALA-guided; consumes
#                core.online drift signals for mid-run recalibration)
#   adapter    — steady-state windows -> core.dataset.Dataset rows
#                (the delta feed for core.online.OnlineALA)
#   faults     — seed-deterministic fault plans (crash/restart cycles,
#                straggler windows, telemetry corruption) injected into
#                the simulator and the adapter stream
# Observability (spans, mergeable histograms, calibration audit,
# Perfetto export) hooks in via SimConfig.obs / ALAAutoscaler(obs=...)
# and lives in repro_torch.obs.
