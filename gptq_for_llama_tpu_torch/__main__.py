import sys

if len(sys.argv) > 1 and sys.argv[1] == "serve":
    from .cli.serve import main

    main(sys.argv[2:])
else:
    from .cli.main import main

    main()
