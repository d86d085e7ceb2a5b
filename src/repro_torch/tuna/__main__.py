from repro_torch.tuna.cli import main

if __name__ == "__main__":
    raise SystemExit(main())
