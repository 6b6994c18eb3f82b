import time

STARTED = time.monotonic()  # before any heavy import: set-up counts from here

if __name__ == "__main__":
    import sys

    from portbench.run import main

    sys.exit(main(started=STARTED))
