"""The serve layer of the port: so far only ``knobs`` (the
``SchedulerKnobs`` presets that ``exp.registry.SERVE`` holds).  The trace
generator, the HyDRA KV scheduler, replay and the serve API are ROADMAP.md
Queue 1 item 12."""
