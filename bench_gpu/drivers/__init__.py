"""Pass drivers, one module per kind of pass, named by a mix's ``driver``
key (``drivers/<driver>.py``). Each has ``prepare(config, mix, status_dir,
log)``, which does the set-up that kind of pass needs and returns an
object with ``run_pass(index, spans)`` and ``setup_parts`` (seconds of
set-up by name, for the readers)."""
