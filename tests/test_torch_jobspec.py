"""The port's HCL jobspec parser (`nomad_tpu_torch.jobspec`) against the
JAX package's, case by case.

Each case of the reference's `tests/test_jobspec.py` runs on both
packages (`pkg` = "ref" or "port") and must give the same outcome; one
more case parses a jobspec that uses every block the parser knows with
both packages and compares the two `Job`s field by field through each
package's own `utils/codec` wire encoding."""
import pytest

from nomad_tpu import jobspec as ref_jobspec
from nomad_tpu.utils import codec as ref_codec
from nomad_tpu_torch import jobspec as port_jobspec
from nomad_tpu_torch.utils import codec as port_codec

PKGS = {"ref": ref_jobspec, "port": port_jobspec}
BOTH = pytest.mark.parametrize("pkg", ["ref", "port"])


@BOTH
def test_parse_duration(pkg):
    js = PKGS[pkg]
    assert js.parse_duration_s("30s") == 30
    assert js.parse_duration_s("5m") == 300
    assert js.parse_duration_s("1h30m") == 5400
    assert js.parse_duration_s("500ms") == 0.5
    assert js.parse_duration_s(45) == 45
    with pytest.raises(js.JobspecParseError):
        js.parse_duration_s("ten minutes")


@BOTH
def test_hcl_basics(pkg):
    js = PKGS[pkg]
    b = js.parse_hcl('''
      a = "x"          # comment
      n = 3            // comment
      f = 1.5
      t = true
      l = [1, "two", true]
      m = { k = "v", n = 2 }
      /* block
         comment */
      blk "label1" "label2" { inner = 1 }
    ''')
    assert b.attrs["a"] == "x" and b.attrs["n"] == 3
    assert b.attrs["f"] == 1.5 and b.attrs["t"] is True
    assert b.attrs["l"] == [1, "two", True]
    assert b.attrs["m"] == {"k": "v", "n": 2}
    (labels, body), = b.blocks_named("blk")
    assert labels == ["label1", "label2"] and body.attrs["inner"] == 1


@BOTH
def test_hcl_heredoc(pkg):
    js = PKGS[pkg]
    b = js.parse_hcl('x = <<EOF\nline1\n  line2\nEOF\ny = 1')
    assert b.attrs["x"] == "line1\n  line2"
    assert b.attrs["y"] == 1
    b2 = js.parse_hcl('x = <<-EOF\n\tindented\n\tEOF\n')
    assert b2.attrs["x"].strip() == "indented"


@BOTH
def test_hcl_errors(pkg):
    js = PKGS[pkg]
    with pytest.raises(js.HCLParseError):
        js.parse_hcl('a = ')
    with pytest.raises(js.HCLParseError):
        js.parse_hcl('a = "unterminated')
    with pytest.raises(js.HCLParseError):
        js.parse_hcl('a = 1\na = 2')          # duplicate key


@BOTH
def test_minimal_job(pkg):
    js = PKGS[pkg]
    job = js.parse_job('''
      job "min" {
        group "g" {
          task "t" {
            driver = "mock_driver"
          }
        }
      }
    ''')
    assert job.id == "min" and job.type == "service"
    assert job.task_groups[0].tasks[0].driver == "mock_driver"
    # canonicalize filled the service defaults
    assert job.task_groups[0].reschedule_policy.unlimited


@BOTH
def test_job_level_task_sugar(pkg):
    js = PKGS[pkg]
    job = js.parse_job('''
      job "sugar" {
        type = "batch"
        task "solo" { driver = "mock_driver" }
      }
    ''')
    assert job.task_groups[0].name == "solo"
    assert job.task_groups[0].count == 1


@BOTH
def test_constraint_sugar_forms(pkg):
    js = PKGS[pkg]
    job = js.parse_job('''
      job "c" {
        constraint { attribute = "${attr.arch}"  value = "x86" }
        constraint { attribute = "${attr.kernel.version}"  version = ">= 3.0" }
        constraint { attribute = "${attr.os.name}"  regexp = "ubu.*" }
        constraint { distinct_hosts = true }
        constraint { distinct_property = "${meta.rack}" }
        group "g" { task "t" { driver = "mock_driver" } }
      }
    ''')
    ops = [c.operand for c in job.constraints]
    assert ops == ["=", "version", "regexp", "distinct_hosts",
                   "distinct_property"]
    assert job.constraints[4].ltarget == "${meta.rack}"


@BOTH
def test_unknown_key_rejected(pkg):
    js = PKGS[pkg]
    with pytest.raises(js.JobspecParseError, match="invalid key"):
        js.parse_job('''
          job "bad" {
            bogus_key = true
            group "g" { task "t" { driver = "x" } }
          }
        ''')
    with pytest.raises(js.JobspecParseError, match="invalid key"):
        js.parse_job('''
          job "bad2" {
            group "g" {
              task "t" { driver = "x"  resources { cpus = 100 } }
            }
          }
        ''')


@BOTH
def test_periodic_and_parameterized(pkg):
    js = PKGS[pkg]
    job = js.parse_job('''
      job "cron" {
        type = "batch"
        periodic {
          cron = "*/15 * * * *"
          prohibit_overlap = true
          time_zone = "America/New_York"
        }
        group "g" { task "t" { driver = "mock_driver" } }
      }
    ''')
    assert job.periodic.spec == "*/15 * * * *"
    assert job.periodic.prohibit_overlap
    assert job.periodic.timezone == "America/New_York"
    job2 = js.parse_job('''
      job "param" {
        type = "batch"
        parameterized {
          payload = "required"
          meta_required = ["input"]
        }
        group "g" { task "t" { driver = "mock_driver" } }
      }
    ''')
    assert job2.parameterized.payload == "required"
    assert job2.is_parameterized()


@BOTH
def test_validation_errors_surface(pkg):
    js = PKGS[pkg]
    with pytest.raises(js.JobspecParseError, match="no tasks"):
        js.parse_job('job "empty" { group "g" { } }')
    with pytest.raises(js.JobspecParseError, match="exactly one"):
        js.parse_job('x = 1')


@BOTH
def test_system_job_and_devices(pkg):
    js = PKGS[pkg]
    job = js.parse_job('''
      job "sys" {
        type = "system"
        group "g" {
          task "t" {
            driver = "mock_driver"
            resources {
              cpu = 200
              device "nvidia/gpu/1080ti" {
                count = 2
                constraint { attribute = "${device.attr.memory_mib}"
                             operator = ">"  value = "8000" }
              }
            }
          }
        }
      }
    ''')
    dev = job.task_groups[0].tasks[0].resources.devices[0]
    assert dev.name == "nvidia/gpu/1080ti" and dev.count == 2
    assert dev.constraints[0].operand == ">"


#: a jobspec that uses every block and sugar form the parser knows
RICH = '''
job "rich" {
  region = "global"
  namespace = "default"
  type = "batch"
  priority = 70
  all_at_once = false
  datacenters = ["dc0", "dc1"]
  meta { owner = "ops"  tier = "2" }
  constraint { attribute = "${attr.kernel.name}"  value = "linux" }
  constraint { attribute = "${attr.rack}"  operator = "!="  value = "r63" }
  constraint { attribute = "${attr.kernel.version}"  version = ">= 3.0" }
  constraint { attribute = "${meta.tags}"  set_contains = "a,b" }
  constraint { distinct_property = "${meta.rack}" }
  affinity { attribute = "${attr.rack}"  value = "r7"  weight = 35 }
  affinity { attribute = "${meta.tags}"  set_contains_any = "x,y" }
  spread {
    attribute = "${node.datacenter}"
    weight = 50
    target "dc0" { percent = 60 }
    target { value = "dc1"  percent = 40 }
  }
  update { max_parallel = 2  stagger = "10s"  min_healthy_time = "5s" }
  periodic {
    cron = "*/5 * * * *"
    prohibit_overlap = true
    time_zone = "Europe/Berlin"
  }
  group "g" {
    count = 3
    stop_after_client_disconnect = "90s"
    constraint { distinct_hosts = true }
    restart { attempts = 4  interval = "10m"  delay = "20s"  mode = "fail" }
    reschedule {
      attempts = 3
      interval = "1h"
      delay = "30s"
      delay_function = "exponential"
      max_delay = "10m"
      unlimited = false
    }
    ephemeral_disk { sticky = true  size = 500  migrate = true }
    update {
      max_parallel = 3
      health_check = "task_states"
      min_healthy_time = "15s"
      healthy_deadline = "3m"
      progress_deadline = "12m"
      auto_revert = true
      auto_promote = true
      canary = 1
    }
    migrate {
      max_parallel = 2
      health_check = "task_states"
      min_healthy_time = "20s"
      healthy_deadline = "4m"
    }
    network {
      mbits = 20
      mode = "bridge"
      port "http" { to = 8080 }
      port "admin" { static = 9090  host_network = "private" }
    }
    volume "data" { type = "host"  source = "shared"  read_only = true }
    meta { role = "api" }
    task "t" {
      driver = "exec"
      user = "nobody"
      leader = true
      kill_timeout = "45s"
      kill_signal = "SIGTERM"
      shutdown_delay = "2s"
      config { command = "/bin/app"  args = ["-v", "--port", "8080"] }
      env { MODE = "prod"  LEVEL = "3" }
      meta { build = "77" }
      resources {
        cpu = 750
        memory = 512
        disk = 40
        network { mbits = 10  port "rpc" {} }
        device "nvidia/gpu" {
          count = 1
          constraint { attribute = "${device.attr.memory_mib}"
                       operator = ">="  value = "8000" }
          affinity { attribute = "${device.model}"  value = "A100"
                     weight = 40 }
        }
      }
      service {
        name = "api"
        port = "http"
        tags = ["v1", "blue"]
        canary_tags = ["canary"]
        address_mode = "host"
        check {
          name = "alive"
          type = "http"
          path = "/health"
          interval = "15s"
          timeout = "3s"
          port = "http"
        }
        check { type = "script"  command = "/bin/check"  args = ["-q"] }
      }
      volume_mount { volume = "data"  destination = "/srv"  read_only = true }
      template {
        data = <<EOT
port = {{ env "NOMAD_PORT_http" }}
EOT
        destination = "local/app.conf"
        change_mode = "signal"
        change_signal = "SIGHUP"
      }
      artifact {
        source = "https://example.com/app.tgz"
        destination = "local/app"
        options { checksum = "sha256:abcd" }
      }
      dispatch_payload { file = "input.json" }
      logs { max_files = 4  max_file_size = 20 }
    }
  }
  task "solo" {
    driver = "docker"
    config { image = "redis:7" }
    resources { cpu = 200  memory = 128 }
  }
}
'''


def test_rich_jobspec_parses_to_the_same_job_in_both_packages():
    """The same HCL text through both packages' parsers gives the same
    `Job`, field by field, in each package's own wire encoding."""
    ref_job = ref_jobspec.parse_job(RICH)
    port_job = port_jobspec.parse_job(RICH)
    ref_wire = ref_codec.to_wire(ref_job)
    port_wire = port_codec.to_wire(port_job)
    assert port_wire == ref_wire
    # the blocks reached the job, so the comparison covered them
    tg = port_job.task_groups[0]
    assert [g.name for g in port_job.task_groups] == ["g", "solo"]
    assert tg.tasks[0].services[0].checks[1].command == "/bin/check"
    assert tg.tasks[0].resources.devices[0].affinities[0].weight == 40
    assert port_job.spreads[0].spread_targets[0].percent == 60
    assert port_job.periodic.timezone == "Europe/Berlin"
