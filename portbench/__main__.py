"""``python3 -m portbench``: see :mod:`portbench.run`."""

if __name__ == "__main__":
    import sys

    from portbench.run import main

    sys.exit(main())
