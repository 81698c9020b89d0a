from repro_torch.analysis.cli import main

raise SystemExit(main())
