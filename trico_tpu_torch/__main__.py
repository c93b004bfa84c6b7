"""``python -m trico_tpu_torch`` runs :func:`trico_tpu_torch.cli.main`."""

from .cli import main

raise SystemExit(main())
