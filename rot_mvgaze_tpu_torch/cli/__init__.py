"""The port's command line: ``cli.main.main(argv)``, run as
``python -m rot_mvgaze_tpu_torch``."""
