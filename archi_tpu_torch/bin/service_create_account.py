"""Account-creation entry point: username/password accounts in the app
database.

Counterpart of ``archi_tpu/bin/service_create_account.py`` (reference
``src/bin/service_create_account.py``), over the port's ``build_context``.
Accounts land in the app database's users table (PBKDF2 hashes via
``UserService.set_password``), where the chat app's ``/api/auth/login``
verifies them.  The context's store is built on the card unless ``main``
is given ``device="cpu"``.

Usage:
  python -m archi_tpu_torch.bin.service_create_account [config.yaml ...]
  python -m archi_tpu_torch.bin.service_create_account --email a@b \\
      --password pw [--roles user,admin]   # non-interactive
"""

from __future__ import annotations

import argparse
import getpass
import sys

from archi_tpu_torch.bin.bootstrap import build_context


def create_account(users, email: str, password: str,
                   roles=None) -> None:
    users.create_user(email, roles=roles or ["user"])
    if roles:
        users.set_roles(email, list(roles))
    users.set_password(email, password)


def main(argv=None, *, device=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("configs", nargs="*")
    ap.add_argument("--email")
    ap.add_argument("--password")
    ap.add_argument("--roles", default="user")
    args = ap.parse_args(argv)
    ctx = build_context(args.configs, device=device)
    roles = [r.strip() for r in args.roles.split(",") if r.strip()]

    if args.email:
        if not args.password:
            print("--password required with --email", file=sys.stderr)
            raise SystemExit(2)
        create_account(ctx.users, args.email, args.password, roles)
        print(f"account created: {args.email} roles={roles}")
        return

    while True:
        email = input("Enter email (or 'STOP' to quit): ").strip()
        if email.upper() == "STOP":
            break
        pw1 = getpass.getpass("Enter password: ")
        pw2 = getpass.getpass("Enter password again: ")
        if pw1 != pw2:
            print("Passwords did not match, please try again")
            continue
        create_account(ctx.users, email, pw1, roles)
        print("Account created")
    print("Exiting.")


if __name__ == "__main__":
    main()
