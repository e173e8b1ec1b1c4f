from quickmer2.cli import main

raise SystemExit(main())
