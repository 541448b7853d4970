"""archi-tpu-torch CLI — deploy, manage and evaluate the port.

Counterpart of ``archi_tpu/cli/cli_main.py`` (the reference's ``archi``
console command, ``src/cli/cli_main.py:39`` Click group) with its
subcommands ``create``, ``delete``, ``restart``, ``status``,
``list-services``, ``list-deployments`` and ``evaluate``.  Deployments are
supervised local processes of the port's services
(``archi_tpu_torch.bin.service_*``, ``cli/registry.py``) plus a rendered
compose manifest; see ``archi_tpu_torch.cli.deployment``.

Departure from the JAX package: ``evaluate`` takes ``--device`` (``cuda``,
the card, by default; ``cpu``), where its store is built, and its body is
``cli/evaluate.py::run_evaluate``, which runs without ``click``.
"""

from __future__ import annotations

import json

import click

from archi_tpu_torch.cli.deployment import DeploymentManager, list_deployments
from archi_tpu_torch.cli.registry import SERVICES, SOURCES
from archi_tpu_torch.config.manager import ConfigurationManager


@click.group()
def cli():
    """archi-tpu-torch: the RAG framework on PyTorch and CUDA."""


@cli.command()
@click.option("--name", "-n", required=True, help="deployment name")
@click.option("--config", "-c", "configs", multiple=True,
              type=click.Path(exists=True), help="config YAML (repeatable)")
@click.option("--env-file", "-e", type=click.Path(exists=True),
              help="env file with KEY=VALUE secrets")
@click.option("--services", "only", multiple=True,
              help="start only these services")
def create(name, configs, env_file, only):
    """Create and start a deployment."""
    cm = ConfigurationManager(list(configs), overrides={"name": name})
    cm.validate()
    mgr = DeploymentManager(name)
    started = mgr.start(cm.config, only=list(only) or None,
                        env_file=env_file)
    click.echo(f"deployment {name!r} started:")
    for svc, info in started.items():
        port = f" :{info['port']}" if info.get("port") else ""
        click.echo(f"  {svc}{port}  pid={info['pid']}")
    click.echo(f"artifacts in {mgr.dir}")


@cli.command()
@click.option("--name", "-n", required=True)
@click.option("--keep-files", is_flag=True, help="stop but keep data")
def delete(name, keep_files):
    """Stop (and remove) a deployment."""
    mgr = DeploymentManager(name)
    if not mgr.exists():
        raise click.ClickException(f"no deployment {name!r}")
    if keep_files:
        stopped = mgr.stop()
        click.echo(f"stopped: {', '.join(stopped) or 'nothing running'}")
    else:
        mgr.delete()
        click.echo(f"deployment {name!r} deleted")


@cli.command()
@click.option("--name", "-n", required=True)
def restart(name):
    """Restart a deployment's services."""
    mgr = DeploymentManager(name)
    if not mgr.exists():
        raise click.ClickException(f"no deployment {name!r}")
    import yaml

    with open(f"{mgr.dir}/config.yaml") as f:
        config = yaml.safe_load(f)
    mgr.stop()
    started = mgr.start(config)
    click.echo(f"restarted: {', '.join(started)}")


@cli.command("status")
@click.option("--name", "-n", required=True)
def status(name):
    """Show a deployment's service status."""
    mgr = DeploymentManager(name)
    if not mgr.exists():
        raise click.ClickException(f"no deployment {name!r}")
    for svc, info in mgr.status().items():
        state = "running" if info["alive"] else "stopped"
        click.echo(f"  {svc}: {state} (pid {info.get('pid')})")


@cli.command("list-services")
def list_services():
    """List available services and sources."""
    click.echo("services:")
    for s in SERVICES.values():
        deps = f" (depends on: {', '.join(s.depends_on)})" if s.depends_on else ""
        click.echo(f"  {s.name}: {s.description}{deps}")
    click.echo("sources:")
    for name, spec in SOURCES.items():
        click.echo(f"  {name}: {spec['collector']}")


@cli.command("list-deployments")
def list_deps():
    """List deployments."""
    deps = list_deployments()
    if not deps:
        click.echo("no deployments")
        return
    for d in deps:
        click.echo(f"  {d['name']}: {d['running']}/{len(d['services'])} "
                   f"services running")


@cli.command()
@click.option("--name", "-n", default="evaluate")
@click.option("--config", "-c", "configs", multiple=True,
              type=click.Path(exists=True))
@click.option("--queries", "-q", type=click.Path(exists=True),
              help="queries JSON file (omit with --fixture)")
@click.option("--fixture", is_flag=True,
              help="use the built-in deterministic quality fixture corpus "
                   "+ queries (benchmarking/fixture.py) instead of a "
                   "deployment corpus")
@click.option("--beir", type=click.Path(exists=True),
              help="BEIR-format dataset dir (corpus.jsonl/queries.jsonl/"
                   "qrels) → nDCG@10/recall@k instead of the QA harness "
                   "(BASELINE config 2)")
@click.option("--retriever-mode", default="hybrid",
              type=click.Choice(["hybrid", "semantic", "bm25"]),
              help="retrieval mode for --beir runs")
@click.option("--mode", "-m", multiple=True,
              default=("SOURCES", "RETRIEVAL"),
              type=click.Choice(["SOURCES", "RAGAS", "RETRIEVAL"]))
@click.option("--judge", help="model ref for RAGAS-fallback LLM judging "
                              "(e.g. openai/gpt-4o-mini)")
@click.option("--out", "-o", default="./benchmark_results")
@click.option("--device", default="cuda",
              help="where the store is built: cuda (the card) or cpu")
def evaluate(name, configs, queries, fixture, beir, retriever_mode, mode,
             judge, out, device):
    """Run the quality/retrieval benchmark (reference `archi evaluate`)."""
    from archi_tpu_torch.cli.evaluate import run_evaluate

    if not (beir or fixture or queries):
        raise click.UsageError("--queries required without --fixture")
    result = run_evaluate(configs=configs, queries=queries, fixture=fixture,
                          beir=beir, retriever_mode=retriever_mode,
                          mode=mode, judge=judge, out=out, device=device)
    if beir:
        click.echo(json.dumps(result, indent=2))
        return
    click.echo(json.dumps(result["totals"], indent=2))
    click.echo(f"full report: {out}/results.json, {out}/results.html")


if __name__ == "__main__":
    cli()
