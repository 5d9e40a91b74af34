from .server import main

raise SystemExit(main())
